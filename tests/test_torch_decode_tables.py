"""The decode-table wrapper (``ops/kernels/table_build.py``
``decode_tables``) on the CPU, where it takes its plain version, against
the JAX package's ``decode_tables_device``, the JAX and port host tables
(``decode_rows``, ``decode_tensors``) and the rule the CUDA kernel states
for rows the encoder never writes.  The kernel itself is held to the
plain version on the card (``tests/test_torch_cuda.py``).

Tolerance: exact — int32 tables compared as integers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from data_compression_tpu.huffman import batched as jhb
from data_compression_tpu.ops import table_build as jtbd
from data_compression_tpu_torch.config import ARITY_MAX_LEN
from data_compression_tpu_torch.huffman import batched as hb
from data_compression_tpu_torch.ops.kernels import table_build as ktb
from torch_cases import DECODE_ROW_KINDS, decode_table_rows

ARITIES = [2, 16, 3]
B = 12
KRAFT_KINDS = ("real", "complete", "empty", "one_symbol")  # rows the host builder accepts


@pytest.mark.parametrize("kind", DECODE_ROW_KINDS)
@pytest.mark.parametrize("arity", ARITIES)
def test_decode_tables_match_jax(arity, kind):
    """Every case against JAX ``decode_tables_device``; the rows a code
    can have also against ``decode_rows`` (JAX) and ``decode_tensors``
    (port), whose ``codes_batch`` rejects the others."""
    rows = decode_table_rows(kind, arity, B, 11)
    L = ARITY_MAX_LEN[arity]
    before = ktb.decode_tables.launches
    limit, bmf, symbols = ktb.decode_tables(torch.from_numpy(rows), arity)
    assert ktb.decode_tables.launches == before  # the plain version counts no launch
    assert limit.shape == bmf.shape == (B, L + 1) and symbols.shape == (B, 256)
    assert all(t.dtype == torch.int32 for t in (limit, bmf, symbols))
    jl, jb, js = jtbd.decode_tables_device(jnp.asarray(rows.astype(np.int32)), arity, L)
    for got, want in zip((limit, bmf, symbols), (jl, jb, js)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    if kind in KRAFT_KINDS:
        lengths = rows.astype(np.int64)
        dr = jhb.decode_rows(jhb.codes_batch(lengths, arity), L)
        assert np.array_equal(limit.numpy(), dr["limit_scaled"].astype(np.int32))
        assert np.array_equal(bmf.numpy(), dr["base_minus_first"].astype(np.int32))
        assert np.array_equal(symbols.numpy(), dr["symbols"])
        tensors = hb.decode_tensors(hb.codes_batch(lengths, arity), "cpu")
        for got, want in zip((limit, bmf, symbols), tensors.values()):
            assert torch.equal(got, want)
    else:
        with pytest.raises(ValueError, match="Kraft|exceeds"):
            hb.codes_batch(rows.astype(np.int64), arity)
    if kind == "complete":
        assert int(limit[0, L]) == arity**L  # a complete tree's last limit


def _stated(row, arity):
    """The kernel's rule (``csrc/decode_tables.cu``) in Python integers:
    counts of lengths 1..L, the first-code recurrence, sums stored as
    their low 32 bits; symbols by (length, symbol)."""
    L = ARITY_MAX_LEN[arity]
    count = [int((row == l).sum()) for l in range(L + 1)]
    count[0] = 0
    max_len = int(row.max())
    low = lambda x: ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    limit, bmf, first, base = [0] * (L + 1), [0] * (L + 1), 0, 0
    for l in range(1, L + 1):
        if max_len >= 1:
            limit[l] = low((first + count[l]) * arity ** (L - l))
        if l <= max_len:
            bmf[l] = low(base - first)
        first, base = (first + count[l]) * arity, base + count[l]
    used = sorted((int(row[s]), s) for s in range(256) if row[s])
    return limit, bmf, [s for _, s in used] + [0] * (256 - len(used))


@pytest.mark.parametrize("arity", ARITIES)
def test_rows_the_encoder_never_writes_follow_the_stated_rule(arity):
    """Lengths above L, over-full trees (every symbol of length 1: at
    n = 16 the sums pass 2**32 and wrap) and random lengths decode as
    the kernel's source states."""
    rows = np.concatenate([decode_table_rows("never_written", arity, 9, 5),
                           decode_table_rows("random", arity, 3, 6)])
    limit, bmf, symbols = ktb.decode_tables(torch.from_numpy(rows), arity)
    for i, row in enumerate(rows):
        want = _stated(row.astype(np.int64), arity)
        assert limit[i].tolist() == want[0], i
        assert bmf[i].tolist() == want[1], i
        assert symbols[i].tolist() == want[2], i
    if arity == 16:
        assert int(limit[1, 1]) == 0  # 256 * 16**6 == 2**32 stored as 0


def test_decode_tables_wrapper_checks_its_input():
    rows = torch.zeros((2, 256), dtype=torch.uint8)
    with pytest.raises(KeyError):
        ktb.decode_tables(rows, 4)
    with pytest.raises(ValueError):
        ktb.decode_tables(rows.to(torch.int32), 2)
    with pytest.raises(ValueError):
        ktb.decode_tables(rows[:, :255], 2)
    limit, bmf, symbols = ktb.decode_tables(rows[:0], 3)
    assert limit.shape == (0, 16) and bmf.shape == (0, 16) and symbols.shape == (0, 256)
