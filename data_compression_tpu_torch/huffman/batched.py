"""Batched canonical-table construction: all blocks at once.

Jax-free copy of ``data_compression_tpu/huffman/batched.py``; the tests
hold every function here equal to its original.  Differences:

  * ``capped_lengths_batch`` is the pure-Python branch only; the native
    C two-queue builder is not ported yet.
  * ``BITS_PER_DIGIT`` and ``PACKED_LEN_SHIFT`` are defined here (the
    originals live in JAX modules).
  * ``TableBatch.from_arrays`` takes the JAX package's table fields, and
    ``to_device`` turns a table batch into the int32 tensors the CUDA
    kernels read: the codec's counterpart of carrying weights over.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from data_compression_tpu_torch.config import ARITY_MAX_LEN
from data_compression_tpu_torch.huffman.tree import huffman_lengths

# Bit-field width of one digit in the packed encode words.
BITS_PER_DIGIT = {2: 1, 3: 2, 16: 4}
# Dense encode entry = (digit count << shift) | packed code, for the
# arities whose pair fits one int32.  The length is packed as the DIGIT
# count, never the bit count.
PACKED_LEN_SHIFT = {2: ARITY_MAX_LEN[2] * BITS_PER_DIGIT[2],
                    16: ARITY_MAX_LEN[16] * BITS_PER_DIGIT[16]}


def capped_lengths_batch(hists: np.ndarray, arity: int) -> np.ndarray:
    """[B, S] histograms -> [B, S] int32 canonical code lengths under
    the per-arity cap: frequencies are halved until the optimal tree
    fits."""
    hists = np.ascontiguousarray(hists, np.int64)
    cap = ARITY_MAX_LEN[arity]
    out = np.empty(hists.shape, np.int32)
    for i in range(hists.shape[0]):
        f = hists[i]
        while True:
            lens = huffman_lengths(f, arity, max_len=64)
            if lens.max(initial=0) <= cap:
                break
            f = np.where(f > 0, (f + 1) // 2, 0)
        out[i] = lens
    return out


@dataclasses.dataclass
class TableBatch:
    """Per-block canonical tables as stacked arrays (see
    canonical.CanonicalTable for field meaning; L = ARITY_MAX_LEN)."""

    arity: int
    lengths: np.ndarray  # [B, S] int32
    codes: np.ndarray  # [B, S] int64
    first_code: np.ndarray  # [B, L+1] int64
    count: np.ndarray  # [B, L+1] int64
    base_index: np.ndarray  # [B, L+1] int64
    sorted_symbols: np.ndarray  # [B, S] int32, zero-padded past n_used
    n_used: np.ndarray  # [B] int32
    max_len: np.ndarray  # [B] int32

    @classmethod
    def from_arrays(cls, d: dict) -> "TableBatch":
        """Build from the JAX package's ``TableBatch`` fields, given as a
        dict of numpy arrays (``dataclasses.asdict`` of it)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        if set(d) != fields:
            raise ValueError(f"table fields {sorted(d)} != {sorted(fields)}")
        return cls(
            arity=int(d["arity"]),
            **{
                k: np.array(v, copy=True)
                for k, v in d.items()
                if k != "arity"
            },
        )

    @property
    def num_blocks(self) -> int:
        return self.lengths.shape[0]

    def table_bytes(self) -> np.ndarray:
        """[B, S] uint8 — each row is the block's wire length table."""
        return self.lengths.astype(np.uint8)


def codes_batch(lengths: np.ndarray, arity: int) -> TableBatch:
    """Batched canonical code assignment, row-identical to
    canonical.lengths_to_codes."""
    lengths = np.ascontiguousarray(lengths, np.int32)
    B, S = lengths.shape
    L = ARITY_MAX_LEN[arity]
    used = lengths > 0
    if lengths.max(initial=0) > L:
        raise ValueError(f"code length {lengths.max()} exceeds {L}")

    count = np.zeros((B, L + 1), np.int64)
    for ln in range(1, L + 1):
        count[:, ln] = (lengths == ln).sum(axis=1)

    # canonical recurrence f[l+1] = (f[l] + count[l]) * n
    first_code = np.zeros((B, L + 1), np.int64)
    for ln in range(1, L):
        first_code[:, ln + 1] = (first_code[:, ln] + count[:, ln]) * arity
    # Kraft validation: codes of length l must fit below n^l
    acc = np.int64(1)
    for ln in range(1, L + 1):
        acc = acc * arity
        bad = first_code[:, ln] + count[:, ln] > acc
        if bad.any():
            raise ValueError(
                f"length table violates Kraft inequality (block {int(np.flatnonzero(bad)[0])})"
            )

    base_index = np.zeros((B, L + 1), np.int64)
    np.cumsum(count[:, :-1], axis=1, out=base_index[:, 1:])

    # symbols sorted by (length, symbol), unused pushed past the end
    sort_key = np.where(used, lengths, np.int32(L + 1))
    order = np.argsort(sort_key, axis=1, kind="stable").astype(np.int32)
    n_used = used.sum(axis=1).astype(np.int32)
    pos = np.arange(S, dtype=np.int64)[None, :]
    valid = pos < n_used[:, None]

    ln_of = np.take_along_axis(lengths, order, axis=1).astype(np.int64)
    ln_cl = np.clip(ln_of, 0, L)
    group_start = np.take_along_axis(base_index, ln_cl, axis=1)
    rank = pos - group_start
    codes_sorted = np.take_along_axis(first_code, ln_cl, axis=1) + rank
    codes = np.zeros((B, S), np.int64)
    np.put_along_axis(
        codes, order.astype(np.int64), np.where(valid, codes_sorted, 0), axis=1
    )

    sorted_symbols = np.where(valid, order, 0).astype(np.int32)
    return TableBatch(
        arity=arity,
        lengths=lengths,
        codes=codes,
        first_code=first_code,
        count=count,
        base_index=base_index,
        sorted_symbols=sorted_symbols,
        n_used=n_used,
        max_len=lengths.max(axis=1).astype(np.int32),
    )


def tables_from_bytes(rows: np.ndarray, arity: int) -> TableBatch:
    """[B, S] uint8 wire length rows -> TableBatch."""
    return codes_batch(np.ascontiguousarray(rows).astype(np.int32), arity)


def packed_rows(tb: TableBatch):
    """Per-symbol little-endian field-packed code words: digit m (in
    stream order, MSB of the code first) sits in field m.
    -> ([B, S] uint32 packed, [B, S] int32 field-bit lengths)."""
    n = tb.arity
    bpd = BITS_PER_DIGIT[n]
    lens = tb.lengths.astype(np.int64)
    codes = tb.codes
    maxlen = int(lens.max(initial=0))
    packed = np.zeros(lens.shape, np.uint64)
    for m in range(maxlen):
        place = np.clip(lens - 1 - m, 0, None)
        digit = (codes // np.int64(n) ** place) % n
        packed |= np.where(m < lens, digit << (m * bpd), 0).astype(np.uint64)
    return packed.astype(np.uint32), (lens * bpd).astype(np.int32)


def dense_rows(tb: TableBatch) -> np.ndarray:
    """Dense 256-entry encode lookup rows: [B, R, 128] int32 (R = 2
    packed ``digits << shift | code``, or 4 split code / bit rows)."""
    B, S = tb.lengths.shape
    if S != 256:
        raise ValueError(f"dense rows need a 256-symbol alphabet, got {S}")
    sh = PACKED_LEN_SHIFT.get(tb.arity)
    bpd = BITS_PER_DIGIT[tb.arity]
    pt, bt = packed_rows(tb)
    pt = np.where(bt > 0, pt, 0)
    if sh is not None:
        digits = bt.astype(np.int64) // bpd
        if int(digits.max(initial=0)) * bpd > sh:
            raise ValueError("code longer than the packed length field")
        packed = ((digits << sh) | pt.astype(np.int64)).astype(np.int32)
        return packed.reshape(B, 2, 128)
    return np.concatenate(
        [
            pt.astype(np.int32).reshape(B, 2, 128),
            bt.astype(np.int32).reshape(B, 2, 128),
        ],
        axis=1,
    )


def decode_rows(tb: TableBatch, pad_to: int):
    """Scaled decode tables as stacked arrays: limit_scaled [B, L+1]
    int64 (monotone), base_minus_first [B, L+1] int64, symbols [B, S]
    int32."""
    L = pad_to
    n = tb.arity
    B = tb.num_blocks
    lsh = min(tb.first_code.shape[1] - 1, L)
    scale = np.int64(n) ** (L - np.arange(L + 1, dtype=np.int64))
    lens_ok = (
        np.arange(L + 1, dtype=np.int64)[None, :]
        <= tb.max_len[:, None].astype(np.int64)
    )
    limit = np.zeros((B, L + 1), np.int64)
    bmf = np.zeros((B, L + 1), np.int64)
    limit[:, 1 : lsh + 1] = np.where(
        lens_ok[:, 1 : lsh + 1],
        (tb.first_code[:, 1 : lsh + 1] + tb.count[:, 1 : lsh + 1])
        * scale[None, 1 : lsh + 1],
        0,
    )
    bmf[:, 1 : lsh + 1] = np.where(
        lens_ok[:, 1 : lsh + 1],
        tb.base_index[:, 1 : lsh + 1] - tb.first_code[:, 1 : lsh + 1],
        0,
    )
    limit = np.maximum.accumulate(limit, axis=1)
    return {
        "limit_scaled": limit,
        "base_minus_first": bmf,
        "symbols": tb.sorted_symbols,
    }


def _int32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def encode_tensors(tb: TableBatch, device) -> dict:
    """``dense`` [B, 256] int32 encode entries on ``device``."""
    return {"dense": _int32(dense_rows(tb).reshape(tb.num_blocks, -1), device)}


def decode_tensors(tb: TableBatch, device) -> dict:
    """The scaled decode tables on ``device``: ``limit`` [B, L+1],
    ``bmf`` [B, L+1] and ``symbols`` [B, 256], all int32."""
    dr = decode_rows(tb, ARITY_MAX_LEN[tb.arity])
    return {
        "limit": _int32(dr["limit_scaled"], device),
        "bmf": _int32(dr["base_minus_first"], device),
        "symbols": _int32(dr["symbols"], device),
    }


def to_device(tb: TableBatch, device) -> dict:
    """Every kernel-side tensor of a table batch on ``device``: the
    encode entries and the decode tables (see encode_tensors and
    decode_tensors)."""
    return {**encode_tensors(tb, device), **decode_tensors(tb, device)}
