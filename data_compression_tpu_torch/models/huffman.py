"""n-ary canonical Huffman codec (n = 2 ... 64) on PyTorch.

Counterpart of ``data_compression_tpu/models/huffman.py``; its frames are
byte-identical.  Block payload layout (all little-endian):

  u8   table_mode      0 = inline table, 1 = stream-shared table
  [inline only] u8[256] canonical length per symbol
  u16  num_chunks
  u16  chunk_bytes[num_chunks]
  chunk payloads, each byte-aligned (digits packed per
        ARITY_DIGITS_PER_BYTE: 8 bits / 5 trits / 2 nybbles / ...)

Two routes, chosen by arity as the JAX codec chooses them:

  * n in FAST_ARITIES (2, 3, 16), on the codec's device.  Encode:
    device histogram -> host canonical tables -> encode kernel -> exact
    block byte totals -> download of the chunk digit counts -> compact
    kernel, sized by their wire bytes (no host read of its own) ->
    download of the payload bytes -> host payload assembly.  Decode: host payload
    parse -> upload of the payload bytes with per-chunk offsets -> decode
    kernel -> download.
  * any other n (the reference's 9/10-ary experiments) has no bit-field
    wire packing and no kernel, in the JAX package as here: the digit-
    generic host path ``encode_chunk_np`` / ``decode_chunk_np`` in pure
    Python, on any device (only the histogram runs there).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from data_compression_tpu_torch.config import (
    ARITY_DIGITS_PER_BYTE,
    ARITY_MAX_LEN,
    FAST_ARITIES,
    max_chunk_bytes,
    wire_bytes,
)
from data_compression_tpu_torch.huffman import batched as hb
from data_compression_tpu_torch.huffman.canonical import CanonicalTable
from data_compression_tpu_torch.huffman.tree import huffman_lengths
from data_compression_tpu_torch.models.base import Codec, EncodeResult
from data_compression_tpu_torch.ops.kernels.histogram import block_histograms
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


def encode_chunk_np(syms: np.ndarray, table: CanonicalTable) -> bytes:
    """One chunk's wire bytes, digit by digit (copy of the JAX package's
    host encoder): the codes' base-n digits MSB first, D to a byte,
    little-endian, the last byte zero-padded."""
    n = table.arity
    D = ARITY_DIGITS_PER_BYTE[n]
    digits: List[int] = []
    for s in syms:
        code = int(table.codes[s])
        ln = int(table.lengths[s])
        assert ln > 0, f"symbol {s} has no code"
        for p in range(ln - 1, -1, -1):
            digits.append((code // n**p) % n)
    while len(digits) % D:
        digits.append(0)
    out = bytearray()
    for k in range(0, len(digits), D):
        b = 0
        for d in range(D):
            b += digits[k + d] * n**d
        out.append(b)
    return bytes(out)


def decode_chunk_np(payload: bytes, count: int, table: CanonicalTable) -> np.ndarray:
    """Inverse of ``encode_chunk_np`` for ``count`` symbols (copy of the
    JAX package's host decoder); a stream that runs out or holds no
    valid code raises ValueError."""
    n = table.arity
    D = ARITY_DIGITS_PER_BYTE[n]
    digits: List[int] = []
    for b in payload:
        for d in range(D):
            digits.append((b // n**d) % n)
    out = np.empty(count, np.uint8)
    off = 0
    for i in range(count):
        value = 0
        ln = 0
        while True:
            ln += 1
            if off + ln > len(digits):
                raise ValueError("truncated huffman chunk")
            value = value * n + digits[off + ln - 1]
            if ln >= len(table.first_code):
                cnt = 0
            else:
                cnt = int(table.count[ln]) if ln < table.count.shape[0] else 0
            if cnt and table.first_code[ln] <= value < table.first_code[ln] + cnt:
                break
            if ln > table.max_len:
                raise ValueError("invalid huffman stream")
        sidx = int(table.base_index[ln]) + value - int(table.first_code[ln])
        out[i] = table.sorted_symbols[sidx]
        off += ln
    return out


def _pack_payload(table_bytes: Optional[bytes], chunk_payloads: List[bytes]) -> bytes:
    """One block's payload from its chunks (copy of the JAX package's
    ``_pack_payload``); ``table_bytes`` None marks a shared-table block."""
    parts = []
    if table_bytes is None:
        parts.append(b"\x01")
    else:
        if len(table_bytes) != 256:
            raise ValueError("huffman table must be 256 bytes")
        parts += [b"\x00", table_bytes]
    parts.append(struct.pack("<H", len(chunk_payloads)))
    parts.append(struct.pack(f"<{len(chunk_payloads)}H", *[len(c) for c in chunk_payloads]))
    parts.extend(chunk_payloads)
    return b"".join(parts)


def _unpack_payload(payload: bytes) -> Tuple[Optional[bytes], List[bytes]]:
    """Inverse of ``_pack_payload`` -> (table bytes or None, chunk
    payloads).  Every parse failure raises ValueError."""
    if not payload:
        raise ValueError("empty huffman payload")
    mode = payload[0]
    off = 1
    table_bytes = None
    if mode == 0:
        table_bytes = payload[1:257]
        if len(table_bytes) != 256:
            raise ValueError("truncated huffman payload (table)")
        off = 257
    elif mode != 1:
        raise ValueError(f"bad huffman table mode {mode}")
    if off + 2 > len(payload):
        raise ValueError("truncated huffman payload (chunk count)")
    (nc,) = struct.unpack_from("<H", payload, off)
    off += 2
    if off + 2 * nc > len(payload):
        raise ValueError("truncated huffman payload (chunk lengths)")
    lens = struct.unpack_from(f"<{nc}H", payload, off)
    off += 2 * nc
    chunks = []
    for ln in lens:
        chunks.append(payload[off : off + ln])
        if len(chunks[-1]) != ln:
            raise ValueError("truncated huffman payload")
        off += ln
    return table_bytes, chunks


class HuffmanCodec(Codec):
    """Huffman codec on ``device``: the CUDA kernels (their plain versions
    on the CPU) for n in FAST_ARITIES, the pure-Python host path for
    every other arity, as the JAX codec dispatches."""

    name = "huffman"

    def _n_chunks(self, raw_len: int) -> int:
        """Chunks in a block's payload: at least one, even when empty."""
        return max(1, -(-raw_len // self.config.chunk_syms))

    # -------------------------- encode --------------------------------

    def encode_blocks(self, blocks: np.ndarray, lengths: np.ndarray) -> EncodeResult:
        if blocks.shape[0] == 0:
            return EncodeResult(payloads=[], shared_table=None)
        lengths = np.asarray(lengths, np.int64)
        arity = self.config.arity
        dev_blocks, dev_lens = self.upload_blocks(blocks, lengths)
        tb, shared_table_bytes = self.tables(dev_blocks, dev_lens)
        table_rows = None if self.config.shared_table else tb.table_bytes()
        if arity not in FAST_ARITIES:
            payloads = self._encode_host(blocks, lengths, tb, table_rows)
            return EncodeResult(payloads=payloads, shared_table=shared_table_bytes)
        dense = hb.encode_tensors(tb, self.device)["dense"]
        rows, digits, block_bytes = kencode.encode_blocks(
            dev_blocks, dev_lens, dense, self.config.chunk_syms, arity
        )
        # the digit counts come down first: their wire bytes sum to the
        # payload total, so the compaction reads nothing back itself
        nb = wire_bytes(digits.cpu().numpy().astype(np.int64), arity)
        flat = kcompact.compact_blocks(rows, block_bytes, total=int(nb.sum()))
        payloads = self._assemble_payloads(flat.cpu().numpy(), nb, lengths, table_rows)
        return EncodeResult(payloads=payloads, shared_table=shared_table_bytes)

    def _encode_host(self, blocks, lengths, tb, table_rows) -> List[bytes]:
        """The host path: every chunk through ``encode_chunk_np``."""
        C = self.config.chunk_syms
        payloads = []
        for i in range(blocks.shape[0]):
            raw_len = int(lengths[i])
            table = tb.table(i)
            chunks = [
                encode_chunk_np(blocks[i, c * C : min(raw_len, (c + 1) * C)], table)
                for c in range(self._n_chunks(raw_len))
            ]
            row = None if table_rows is None else table_rows[i].tobytes()
            payloads.append(_pack_payload(row, chunks))
        return payloads

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
        table_rows: Optional[np.ndarray],  # [B, 256] u8, None in shared mode
    ) -> List[bytes]:
        """Copy of the JAX package's ``_assemble_payloads`` with the
        default tight block starts: block i's payload is
        ``_pack_payload(table_rows[i], its first n_real chunks)``."""
        B, ncb = nb.shape
        C = self.config.chunk_syms
        n_real = np.maximum(1, -(-raw_lens // C)).astype(np.int64)
        block_data = nb.sum(axis=1)
        block_start = np.zeros(B + 1, np.int64)
        np.cumsum(block_data, out=block_start[1:])
        lens16 = nb.astype("<u2")
        mode = b"\x01" if table_rows is None else b"\x00"
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
        if self.config.arity not in FAST_ARITIES:
            return self._decode_host(payloads, raw_lens, shared_table)
        args, n_real = self.decode_inputs(payloads, raw_lens, shared_table)
        out = kdecode.decode_chunks(**args).cpu().numpy()
        result = []
        start = 0
        for nc, raw_len in zip(n_real.tolist(), raw_lens):
            result.append(out[start : start + nc].reshape(-1)[: int(raw_len)].tobytes())
            start += nc
        return result

    def _decode_host(self, payloads, raw_lens, shared_table) -> List[bytes]:
        """The host path: every chunk through ``decode_chunk_np``."""
        arity, C = self.config.arity, self.config.chunk_syms
        shared = None
        out = []
        for payload, raw_len in zip(payloads, raw_lens):
            table_bytes, chunks = _unpack_payload(payload)
            if table_bytes is not None:
                table = CanonicalTable.from_bytes(table_bytes, arity)
            elif shared_table is None:
                raise ValueError("stream requires shared table but frame has none")
            else:
                shared = shared or CanonicalTable.from_bytes(shared_table, arity)
                table = shared
            if len(chunks) != self._n_chunks(int(raw_len)):
                raise ValueError("huffman chunk count mismatch")
            parts = [
                decode_chunk_np(ch, max(0, min(C, int(raw_len) - c * C)), table)
                for c, ch in enumerate(chunks)
            ]
            out.append(np.concatenate(parts)[: int(raw_len)].tobytes())
        return out

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
            arity=arity,
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
