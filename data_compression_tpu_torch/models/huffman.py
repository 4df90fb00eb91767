"""Canonical Huffman codec, n = 2, on PyTorch.

Counterpart of ``data_compression_tpu/models/huffman.py``; its frames are
byte-identical.  Block payload layout (all little-endian):

  u8   table_mode      0 = inline table, 1 = stream-shared table
  [inline only] u8[256] canonical length per symbol
  u16  num_chunks
  u16  chunk_bytes[num_chunks]
  chunk payloads, each byte-aligned (8 binary digits per byte)

Encode: device histogram -> host canonical tables -> encode kernel ->
exact block byte totals -> compact kernel -> download of the payload
bytes and chunk byte counts -> host payload assembly.  Decode: host
payload parse -> upload of the payload bytes with per-chunk offsets ->
decode kernel -> download.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np
import torch

from data_compression_tpu_torch.config import (
    ARITY_MAX_LEN,
    PORTED_ARITIES,
    max_chunk_bytes,
)
from data_compression_tpu_torch.huffman import batched as hb
from data_compression_tpu_torch.huffman.tree import huffman_lengths
from data_compression_tpu_torch.models.base import Codec, EncodeResult
from data_compression_tpu_torch.ops.histogram import block_histograms
from data_compression_tpu_torch.ops.kernels import compact as kcompact
from data_compression_tpu_torch.ops.kernels import decode as kdecode
from data_compression_tpu_torch.ops.kernels import encode as kencode


def capped_lengths(freqs: np.ndarray, arity: int) -> np.ndarray:
    """Huffman lengths under the per-arity cap; frequencies are halved
    until the optimal tree fits."""
    cap = ARITY_MAX_LEN[arity]
    freqs = np.asarray(freqs, np.int64)
    while True:
        lengths = huffman_lengths(freqs, arity, max_len=64)
        if lengths.max(initial=0) <= cap:
            return lengths
        freqs = np.where(freqs > 0, (freqs + 1) // 2, 0)


class HuffmanCodec(Codec):
    name = "huffman"

    def __init__(self, config, device="cuda"):
        super().__init__(config, device)
        if config.arity not in PORTED_ARITIES:
            raise NotImplementedError(
                f"huffman arity {config.arity} is not yet ported"
            )

    def _n_chunks(self, raw_len: int) -> int:
        """Chunks in a block's payload: at least one, even when empty."""
        return max(1, -(-raw_len // self.config.chunk_syms))

    # -------------------------- encode --------------------------------

    def encode_blocks(self, blocks: np.ndarray, lengths: np.ndarray) -> EncodeResult:
        if blocks.shape[0] == 0:
            return EncodeResult(payloads=[], shared_table=None)
        lengths = np.asarray(lengths, np.int64)
        dev_blocks, dev_lens = self.upload_blocks(blocks, lengths)
        tb, shared_table_bytes = self.tables(dev_blocks, dev_lens)
        dense = hb.encode_tensors(tb, self.device)["dense"]
        rows, digits, block_bytes = kencode.encode_blocks(
            dev_blocks, dev_lens, dense, self.config.chunk_syms
        )
        flat = kcompact.compact_blocks(rows, block_bytes)
        nb = (digits.cpu().numpy().astype(np.int64) + 7) // 8
        payloads = self._assemble_payloads(flat.cpu().numpy(), nb, lengths, tb)
        return EncodeResult(payloads=payloads, shared_table=shared_table_bytes)

    def upload_blocks(self, blocks: np.ndarray, lengths: np.ndarray):
        """-> ([B, S] uint8, [B] int32 raw lengths) on the codec's device."""
        dev_blocks = torch.from_numpy(np.ascontiguousarray(blocks, np.uint8))
        dev_lens = torch.from_numpy(np.asarray(lengths).astype(np.int32))
        return dev_blocks.to(self.device), dev_lens.to(self.device)

    def tables(self, dev_blocks: torch.Tensor, dev_lens: torch.Tensor):
        """Device histograms -> host canonical tables: per block, or one
        shared by the stream.  -> (TableBatch, shared table bytes or None)."""
        arity = self.config.arity
        hists = block_histograms(dev_blocks, dev_lens).cpu().numpy()
        if not self.config.shared_table:
            return hb.codes_batch(hb.capped_lengths_batch(hists, arity), arity), None
        lengths_tab = np.asarray(capped_lengths(hists.sum(axis=0), arity), np.int32)
        tb = hb.codes_batch(np.tile(lengths_tab, (hists.shape[0], 1)), arity)
        return tb, lengths_tab.astype(np.uint8).tobytes()

    def _assemble_payloads(
        self,
        flat: np.ndarray,  # block payloads back to back, chunk order
        nb: np.ndarray,  # [B, ncb] per-chunk wire bytes
        raw_lens: np.ndarray,
        tb,
    ) -> List[bytes]:
        """Copy of the JAX package's ``_assemble_payloads`` with the
        default tight block starts."""
        B, ncb = nb.shape
        C = self.config.chunk_syms
        n_real = np.maximum(1, -(-raw_lens // C)).astype(np.int64)
        block_data = nb.sum(axis=1)
        block_start = np.zeros(B + 1, np.int64)
        np.cumsum(block_data, out=block_start[1:])
        shared = self.config.shared_table
        table_rows = None if shared else tb.table_bytes()
        lens16 = nb.astype("<u2")
        mode = b"\x01" if shared else b"\x00"
        payloads = []
        for i in range(B):
            nr = int(n_real[i])
            parts = [mode]
            if table_rows is not None:
                parts.append(table_rows[i].tobytes())
            parts.append(struct.pack("<H", nr))
            parts.append(lens16[i, :nr].tobytes())
            parts.append(
                flat[block_start[i] : block_start[i] + block_data[i]].tobytes()
            )
            payloads.append(b"".join(parts))
        return payloads

    # -------------------------- decode --------------------------------

    def decode_blocks(
        self,
        payloads: List[bytes],
        raw_lens: List[int],
        shared_table: Optional[bytes] = None,
    ) -> List[bytes]:
        if not payloads:
            return []
        args, n_real = self.decode_inputs(payloads, raw_lens, shared_table)
        out = kdecode.decode_chunks(**args).cpu().numpy()
        result = []
        start = 0
        for nc, raw_len in zip(n_real.tolist(), raw_lens):
            result.append(out[start : start + nc].reshape(-1)[: int(raw_len)].tobytes())
            start += nc
        return result

    def decode_inputs(self, payloads, raw_lens, shared_table):
        """Parse the payloads and upload what the decode kernel reads:
        the payload bytes back to back with per-chunk offsets (not padded
        rows), per-chunk symbol counts and table rows, and the scaled
        decode tables.  -> (keyword arguments of ``decode_chunks``,
        chunks per block)."""
        arity = self.config.arity
        C = self.config.chunk_syms
        rows, nb, flat = self._parse_payloads_vec(payloads, raw_lens, shared_table)
        if int(nb.max(initial=0)) > max_chunk_bytes(C, arity):
            raise ValueError("huffman chunk payload too large")
        tb = hb.tables_from_bytes(rows, arity)

        B, ncb = nb.shape
        n_real = np.asarray([self._n_chunks(int(r)) for r in raw_lens], np.int64)
        counts = np.clip(
            np.asarray(raw_lens, np.int64)[:, None]
            - np.arange(ncb, dtype=np.int64)[None, :] * C,
            0,
            C,
        )
        keep = np.arange(ncb)[None, :] < n_real[:, None]  # [B, ncb]
        chunk_off = np.zeros(int(keep.sum()) + 1, np.int64)
        np.cumsum(nb[keep], out=chunk_off[1:])

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

        tabs = hb.decode_tensors(tb, self.device)
        args = dict(
            flat=up(flat, np.uint8),
            chunk_off=up(chunk_off, np.int64),
            chunk_cnt=up(counts[keep], np.int32),
            chunk_blk=up(np.repeat(np.arange(B, dtype=np.int32), n_real), np.int32),
            limit=tabs["limit"],
            bmf=tabs["bmf"],
            symbols=tabs["symbols"],
            chunk_syms=C,
        )
        return args, n_real

    def _parse_payloads_vec(self, payloads, raw_lens, shared_table):
        """Copy of the JAX package's vectorized payload parse.  Returns
        (rows [B,256] u8 length tables, nb [B, ncb] int64 chunk byte
        counts, flat u8 wire bytes).  All corruption surfaces as
        ValueError."""
        B = len(payloads)
        C = self.config.chunk_syms
        ncb = self.config.block_size // C
        rows = np.empty((B, 256), np.uint8)
        shared_row = (
            np.frombuffer(shared_table, np.uint8, 256)
            if shared_table is not None and len(shared_table) >= 256
            else None
        )
        nb = np.zeros((B, ncb), np.int64)
        datas = []
        for i, p in enumerate(payloads):
            if not p:
                raise ValueError("empty huffman payload")
            mode = p[0]
            off = 1
            if mode == 0:
                if len(p) < 257:
                    raise ValueError("truncated huffman payload (table)")
                rows[i] = np.frombuffer(p, np.uint8, 256, 1)
                off = 257
            elif mode == 1:
                if shared_row is None:
                    raise ValueError(
                        "stream requires shared table but frame has none"
                    )
                rows[i] = shared_row
            else:
                raise ValueError(f"bad huffman table mode {mode}")
            if off + 2 > len(p):
                raise ValueError("truncated huffman payload (chunk count)")
            nc = p[off] | (p[off + 1] << 8)
            off += 2
            if off + 2 * nc > len(p):
                raise ValueError("truncated huffman payload (chunk lengths)")
            if nc > ncb:
                raise ValueError("huffman chunk count mismatch")
            if nc != self._n_chunks(int(raw_lens[i])):
                raise ValueError("huffman chunk count mismatch")
            lens = np.frombuffer(p, "<u2", nc, off)
            off += 2 * nc
            total = int(lens.sum())
            if off + total > len(p):
                raise ValueError("truncated huffman payload")
            nb[i, :nc] = lens
            datas.append(np.frombuffer(p, np.uint8, total, off))
        flat = np.concatenate(datas) if datas else np.zeros(0, np.uint8)
        return rows, nb, flat
