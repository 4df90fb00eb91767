"""Canonical n-ary code assignment and decode-table construction (copy
of ``data_compression_tpu/huffman/canonical.py``).

Reproduces the reference's canonical convention exactly
(``convert_lengths_to_encode_table``, n_ary_huffman.c:1382-1612):
scanning lengths from shortest to longest, symbols in increasing symbol
order within a length, assigning consecutive code values, then
``current_code *= n`` per length step (append a zero digit).  This is
the Wikipedia convention the author picked — all-zeros code shortest,
all-ones longest (n_ary_huffman.c:1475-1483).  Codes are digit strings
in base n, MSB-first (most significant digit emitted first).

Verified against the reference's own unit-test vectors
(n_ary_huffman.c:2821-2891) in tests/test_huffman_tables.py.

The decode side uses the standard canonical trick the reference gestures
at (n_ary_huffman.c:1509-1528): per-length first-code values + a base
index into the length-sorted symbol list, so decoding is a handful of
comparisons — branch-free and vectorizable on TPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from data_compression_tpu_torch.config import MAX_CODE_LEN


@dataclasses.dataclass
class CanonicalTable:
    """Everything encode and decode need, derived from lengths alone.

    Attributes:
      arity: base n of the output digits.
      lengths: [S] digits per symbol (0 = symbol unused).
      codes: [S] code value of each symbol (integer of ``lengths[s]``
        base-n digits, MSB first).
      first_code: [max_len+1] canonical first code value per length.
      count: [max_len+1] number of symbols per length.
      base_index: [max_len+1] running count of symbols with shorter
        lengths (offset into ``sorted_symbols``).
      sorted_symbols: [S_used] symbols sorted by (length, symbol).
      max_len / min_len: bounds over used symbols.
    """

    arity: int
    lengths: np.ndarray
    codes: np.ndarray
    first_code: np.ndarray
    count: np.ndarray
    base_index: np.ndarray
    sorted_symbols: np.ndarray
    max_len: int
    min_len: int

    def to_bytes(self) -> bytes:
        """Wire form: just the length array (one byte per symbol), the
        same information the reference's '\\nX' header carries as one
        digit per symbol (n_ary_huffman.c:1736-1741)."""
        assert self.lengths.max(initial=0) < 256
        return np.asarray(self.lengths, dtype=np.uint8).tobytes()

    @classmethod
    def from_bytes(cls, data: bytes, arity: int) -> "CanonicalTable":
        lengths = np.frombuffer(data, dtype=np.uint8).astype(np.int32)
        return lengths_to_codes(lengths, arity)


def lengths_to_codes(lengths: np.ndarray, arity: int) -> CanonicalTable:
    """Assign canonical codes from lengths (reference convention)."""
    lengths = np.asarray(lengths, dtype=np.int32)
    S = lengths.shape[0]
    used = lengths > 0
    if not used.any():
        z = np.zeros(1, dtype=np.int64)
        return CanonicalTable(
            arity, lengths, np.zeros(S, np.int64), z, z, z,
            np.zeros(0, np.int64), 0, 0,
        )
    max_len = int(lengths[used].max())
    min_len = int(lengths[used].min())
    if max_len > MAX_CODE_LEN:
        raise ValueError(f"code length {max_len} exceeds {MAX_CODE_LEN}")

    count = np.bincount(lengths[used], minlength=max_len + 1).astype(np.int64)
    # first_code[l]: value of the first code of length l, canonical
    # recurrence f[l+1] = (f[l] + count[l]) * n  (append-zero-digit).
    first_code = np.zeros(max_len + 1, dtype=np.int64)
    for ln in range(min_len, max_len):
        first_code[ln + 1] = (first_code[ln] + count[ln]) * arity
    # Kraft validation: codes of length l must fit below n^l.
    acc = 1
    for ln in range(1, max_len + 1):
        acc = acc * arity
        used_here = int(count[ln]) if ln < count.shape[0] else 0
        if first_code[ln] + used_here > acc:
            raise ValueError("length table violates Kraft inequality")

    base_index = np.zeros(max_len + 1, dtype=np.int64)
    np.cumsum(count[:-1], out=base_index[1:])

    codes = np.zeros(S, dtype=np.int64)
    # Symbols sorted by (length, symbol): stable argsort on length over
    # used symbols reproduces the reference's per-length symbol-order
    # scan (n_ary_huffman.c:1547-1563).
    syms = np.flatnonzero(used)
    order = syms[np.argsort(lengths[syms], kind="stable")]
    # rank within its length group:
    ln_of = lengths[order]
    group_start = base_index[ln_of]
    rank = np.arange(order.size) - group_start
    codes[order] = first_code[ln_of] + rank
    return CanonicalTable(
        arity=arity,
        lengths=lengths,
        codes=codes,
        first_code=first_code,
        count=count,
        base_index=base_index,
        sorted_symbols=order,
        max_len=max_len,
        min_len=min_len,
    )


def build_decode_tables(table: CanonicalTable, pad_to: int = MAX_CODE_LEN):
    """Fixed-shape device arrays for the branch-free canonical decoder.

    Returns dict of numpy arrays, all padded to ``pad_to + 1`` lengths so
    every block's tables stack into one [num_blocks, ...] device array:
      first_scaled: [L+1] first_code[l] * n^(L-l)  — compare against the
        full-window value so the decoder never re-slices digits.
      limit_scaled: [L+1] (first_code[l]+count[l]) * n^(L-l); a window
        value v has code length l iff v < limit_scaled[l] for the
        smallest such l.
      base_minus_first: [L+1] base_index[l] - first_code[l].
      symbols: [S_used padded to S] length-sorted symbol list.
    """
    L = pad_to
    n = table.arity
    S = table.lengths.shape[0]
    first_scaled = np.full(L + 1, np.iinfo(np.int64).max, dtype=np.int64)
    limit_scaled = np.zeros(L + 1, dtype=np.int64)
    base_minus_first = np.zeros(L + 1, dtype=np.int64)
    for ln in range(1, min(table.max_len, L) + 1):
        scale = n ** (L - ln)
        cnt = int(table.count[ln]) if ln < table.count.shape[0] else 0
        first_scaled[ln] = table.first_code[ln] * scale
        limit_scaled[ln] = (table.first_code[ln] + cnt) * scale
        base_minus_first[ln] = table.base_index[ln] - table.first_code[ln]
    # Monotone limits: unused lengths inherit the previous limit so the
    # decoder's "count of limits <= window" formula yields the code
    # length directly (ops/huffman_coding.py).
    limit_scaled = np.maximum.accumulate(limit_scaled)
    symbols = np.zeros(S, dtype=np.int32)
    symbols[: table.sorted_symbols.size] = table.sorted_symbols
    return {
        "first_scaled": first_scaled,
        "limit_scaled": limit_scaled,
        "base_minus_first": base_minus_first,
        "symbols": symbols,
        "max_len": np.int32(table.max_len),
        "min_len": np.int32(max(table.min_len, 1)),
    }



def expected_payload_digits(freqs: np.ndarray, lengths: np.ndarray) -> int:
    """Sum of freq*length — the reference's ``find_compressed_data_size``
    payload estimate (n_ary_huffman.c:2466-2506)."""
    return int((np.asarray(freqs, np.int64) * np.asarray(lengths, np.int64)).sum())
